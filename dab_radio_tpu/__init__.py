"""dab_radio_tpu — a DAB software-defined-radio framework for one or more
GPUs.

A from-scratch JAX/XLA re-design of the capabilities of the C++ reference
receiver williamyang98/DAB-Radio (see SURVEY.md): OFDM demodulation of 2.048 MSPS
IQ streams, full DAB digital decode (FIC/FIG ensemble database, MSC subchannels,
punctured Viterbi, Reed-Solomon/firecode, AAC/MP2 audio, PAD/MOT data), a
transmitter simulator, and mesh-sharded multi-ensemble scaling.

Design stance (SURVEY.md §7): the reference is a streaming state machine over
scalars; this framework is a batched tensor program over fixed-shape blocks with
an explicit carry pytree. Acquisition/tracking become block-parallel tensor ops,
the 77-thread symbol pipeline becomes one batched FFT, the subchannel thread pool
becomes vmap over padded subchannel tables, and multi-ensemble scale-out is a
jax.sharding Mesh over the ensemble axis.
"""

__version__ = "0.1.0"
