import sys

from vq_tpu_torch.cli import main

sys.exit(main())
