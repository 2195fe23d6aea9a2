"""Editions of the reference's core entry points that route their device
work through the port (kmer_counter, spss decode, kmer_set_compact)."""
