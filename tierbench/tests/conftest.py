import sys
from pathlib import Path

# the port lives under src/, as the benchmark's command line puts it
_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
