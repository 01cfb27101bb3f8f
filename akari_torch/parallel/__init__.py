"""Rendering and the pixel loss (``akari_tpu/parallel``); one device until
multi-GPU arrives with slice 6."""
