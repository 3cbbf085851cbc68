"""`python -m paddle_tpu_torch.distributed.launch` — counterpart of
`python -m paddle_tpu.distributed.launch` (Paddle's launch/main.py:18)."""
import sys

from .controller import launch

if __name__ == "__main__":
    sys.exit(launch())
