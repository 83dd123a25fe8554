"""python -m tpu3drecon_torch: the command line (tpu3drecon_torch/cli.py)."""

from tpu3drecon_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
