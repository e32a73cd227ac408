"""Evaluation: the FID InceptionV3 (``inception.py``) and the metrics and
feature extractors of the reference evaluator (``metrics.py``)."""
