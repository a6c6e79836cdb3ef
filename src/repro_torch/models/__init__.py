"""Model layers, embedding and the paged serving steps."""
