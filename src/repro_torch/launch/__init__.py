"""Launchers of the port: calibrate + quantize, and the serving demo."""
