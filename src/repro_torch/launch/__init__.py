"""Entry points of the port (`launch/serve.py`: the serving entry point)."""
