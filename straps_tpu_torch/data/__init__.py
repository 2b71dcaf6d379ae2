"""Host IO: batched reads of cached .npy files."""
