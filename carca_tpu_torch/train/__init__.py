"""The train step (counterpart of ``carca_tpu/train``)."""
