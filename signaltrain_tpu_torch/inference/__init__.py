"""Long-audio inference."""
