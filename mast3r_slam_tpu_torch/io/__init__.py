"""Host-side dataset IO: image preprocessing, dataset adapters, exports."""
