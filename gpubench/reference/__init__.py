"""Plain PyTorch and NumPy references of the benchmark: they import
neither JAX nor anything of the program under test."""
