"""Predictive health scoring, ported to PyTorch.

telemetry.py holds the probe-telemetry ring and the in-daemon scorer,
predictor.py the model, its forward pass and its training step,
convert.py the weight format, train.py training, export and evaluation.
"""
