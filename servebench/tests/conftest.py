"""The benchmark's CPU tests: ``python -m pytest servebench/tests`` from
the root of the repository (the repository's own suite collects only
``tests/``)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
