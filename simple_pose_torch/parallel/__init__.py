"""Host-to-device staging of input batches."""
