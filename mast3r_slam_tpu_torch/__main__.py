"""``python -m mast3r_slam_tpu_torch``: the SLAM command line (``cli.py``)."""

from .cli import main

if __name__ == "__main__":
    main()
