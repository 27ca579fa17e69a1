"""python -m mpmcxx_tpu_torch.validate <study> [--steps N] [--seed S]
[--device cuda|cpu]: see the package docstring."""

import sys

from .cli import main

sys.exit(main())
