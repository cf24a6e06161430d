"""Predictive health scoring, ported to PyTorch.

telemetry.py holds the probe-telemetry ring and the in-daemon scorer,
predictor.py the model and its forward pass, convert.py the weight
format, train.py the recorded-trace replay.
"""
