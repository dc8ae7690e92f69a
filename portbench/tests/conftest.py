import os
import sys

# the helpers beside the tests (tiny.py) import by name
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
