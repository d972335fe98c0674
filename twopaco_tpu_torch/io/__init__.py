"""Host I/O: FASTA parsing, window batching, junction-list writing."""
