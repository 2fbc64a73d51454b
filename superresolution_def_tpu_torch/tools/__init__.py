"""Command-line tools of the port that are not part of ``sr`` (run each with ``python -m``)."""
