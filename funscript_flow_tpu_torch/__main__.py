"""``python -m funscript_flow_tpu_torch <input> [flags]``: the headless CLI."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
