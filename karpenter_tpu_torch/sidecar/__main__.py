"""`python -m karpenter_tpu_torch.sidecar` — run the solver sidecar."""

import sys

from karpenter_tpu_torch.sidecar.server import main

sys.exit(main())
