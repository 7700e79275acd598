"""Models: layers, backbones, necks, heads, detectors and their builder."""
