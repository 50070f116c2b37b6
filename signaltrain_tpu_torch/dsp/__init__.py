"""Effects: the comp_4c compressor and its envelope smoother."""
