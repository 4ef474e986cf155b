import sys

from chromosome3d_tpu_torch.cli import main

sys.exit(main())
