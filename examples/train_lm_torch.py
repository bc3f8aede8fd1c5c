"""LM training driver on the PyTorch/CUDA port (smoke scale), as
examples/train_lm.py: `repro_torch.launch.train` with `--arch gemma2-2b
--smoke` unless the arguments name others.

  python examples/train_lm_torch.py --steps 20                  # on the card
  python examples/train_lm_torch.py --steps 2 --device cpu      # on the CPU

Uses the same fault-tolerant TrainLoop as the walk engine (checkpoint /
restart / straggler monitor).
"""
import contextlib
import io
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402


class _Tee(io.TextIOBase):
    """Writes through to `out` and keeps a copy."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, s: str) -> int:
        self.out.write(s)
        return self.kept.write(s)

    def flush(self) -> None:
        self.out.flush()


def main(argv=None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--arch" not in argv:
        argv += ["--arch", "gemma2-2b"]
    if "--smoke" not in argv:
        argv += ["--smoke"]
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        train_main(argv)
    return tee.kept.getvalue().splitlines()


if __name__ == "__main__":
    main()
