"""Math helpers: SoA vectors on tensors, host matrices, golden-file IO."""
