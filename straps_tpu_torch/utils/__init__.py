"""Device selection, checkpoints, image and PNG IO, profiling and parameter
counts."""
