"""Data: LR/HR pair datasets, augmentation, cached expert features."""
