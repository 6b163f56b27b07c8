"""python -m avi_talking_tpu_torch.cli"""

from . import main

if __name__ == "__main__":
    raise SystemExit(main())
