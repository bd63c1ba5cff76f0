"""The harness's own tests run from the checkout's root, beside the
program they drive."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
