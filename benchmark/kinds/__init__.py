"""The kinds of cell, one module each, found by the ``kind`` that a
traffic mix names (``harness/cells.py`` says what a kind gives)."""
