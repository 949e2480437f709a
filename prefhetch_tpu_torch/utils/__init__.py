"""Host helpers: config presets, binary wire codec, the nvcc build helper."""
