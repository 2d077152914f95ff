"""Launchers: ``serve.py`` (batched prefill + decode)."""
