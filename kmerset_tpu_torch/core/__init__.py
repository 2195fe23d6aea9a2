"""The port's host layer and its device-routed entry points: copies of the
reference's host modules (kmer, config, arrays, kmer_set, strings, io,
native, graph, the host half of spss) and the port's own counter, compact
set, multi-set and SPSS build and decode on a device."""
