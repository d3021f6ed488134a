"""`python -m plz4_tpu_torch`: the plz4 CLI (reference: cmd/plz4); its device
backend runs on the CUDA GPU."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
