"""Build and load of the hand-written CUDA kernels (see `_build.py`)."""
