"""Host helpers the port needs: plane encodings and hybrid-time constants."""
