"""The harness's own tests: ``python3 -m pytest portbench/tests -q`` from
the root of the repository (CPU; the ``gpu`` tests skip without a card and
run on one as ``python3 -m pytest portbench/tests -q -m gpu``)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
