"""Tensor ops: DCNv2 (exact op, kernel path), decode, gaussian targets."""
