"""Device selection, numeric settings and the PNG writer."""
