"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from the
root of the checkout.  They put the benchmark's folder and the checkout's
root on the import path, as ``run.py`` does."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))):
    if path not in sys.path:
        sys.path.insert(0, path)
