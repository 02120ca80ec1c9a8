"""Layers, VGG trunk and weight conversion of the port."""
