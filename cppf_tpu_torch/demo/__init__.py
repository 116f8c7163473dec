"""The single-instance demo (counterpart of ``demo/``)."""
