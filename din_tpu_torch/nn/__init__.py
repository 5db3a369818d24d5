"""Layers, backbones and the weight converter of the port."""
