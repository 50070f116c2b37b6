"""Device selection and model loading."""
