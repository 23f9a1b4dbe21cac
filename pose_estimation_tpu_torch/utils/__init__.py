"""Host-side utilities: the TensorBoard event writer and the pose
overlays."""
