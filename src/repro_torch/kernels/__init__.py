"""The port's Hopper kernels (CUDA C++ sources in `csrc/`, built at first
use by `_build.py`), each beside its plain PyTorch version; `ops.py` holds
the wrappers the core calls."""
