"""Frozen feature extractors for perceptual losses (VGG16 / VGG19 / OBST's
caffe VGG19)."""
