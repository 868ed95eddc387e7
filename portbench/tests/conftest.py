"""The benchmark's own tests: CPU at test sizes; the ``gpu``-marked ones
skip without a card (``python -m pytest portbench/tests -m gpu`` on it)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
