"""The benchmark's tests import ``portbench`` from the repository's root."""
import sys
from pathlib import Path

REPO = str(Path(__file__).resolve().parents[2])
if REPO not in sys.path:
    sys.path.insert(0, REPO)
