"""``python -m lmrs_tpu_torch.analysis`` == the ``lmrs-lint-torch`` console
script (importing this module runs nothing)."""

import sys

from lmrs_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
