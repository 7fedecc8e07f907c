"""Configurations ported so far: the paper's own VGG-9 setup."""
