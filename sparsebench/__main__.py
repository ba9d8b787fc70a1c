"""``python -m sparsebench`` entry point (reference ``sparseBench``)."""

import sys

from sparsebench.cli import main

sys.exit(main())
