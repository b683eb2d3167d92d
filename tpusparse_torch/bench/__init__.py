"""CUDA-event timing and flop/byte models."""
