"""Entry points: the serving engine and its CLI (``launch/serve.py``)."""
