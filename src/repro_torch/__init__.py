"""PyTorch/CUDA port of the Wharf streaming random-walk system.

It mirrors the JAX package `repro` module for module and is held against
it bit for bit on the same inputs and keys. Plain tensor code is PyTorch;
each Pallas TPU kernel of the ported slice is a CUDA kernel written for
Hopper (`kernels/csrc/`), built at first use. Entry points run on the card
unless the caller passes `device="cpu"`.

Code representation: see `repro_torch._u64` (u64 codes as int64 XOR 2^63,
u32 columns as int32 bits).
"""

# the core first: its modules and the kernel wrappers import each other, and
# this order initialises every one of them whichever module is asked for
from repro_torch import core  # noqa: E402,F401
