"""``python -m repro_torch.daemon`` -> the daemon CLI of the port."""
from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
