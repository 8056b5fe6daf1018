"""Run one cell of the port's serving benchmark once (see
``servebench/harness/cli.py``):

  python3 servebench/run.py --workload edge-6b.paper-mix --seed 7 \\
      --seconds 20 --trace 0
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":
    from servebench.harness import cli
    sys.exit(cli.main(sys.argv[1:], started=cli.process_start()))
