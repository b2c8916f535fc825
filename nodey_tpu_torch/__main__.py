import sys

from nodey_tpu_torch.app.cli import main

sys.exit(main())
