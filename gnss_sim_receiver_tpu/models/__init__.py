"""Receiver-stage engines: acquisition, tracking, telemetry, observables,
PVT — the batched device equivalents of the reference's signal-processing
blocks (src/algorithms/<stage>/gnuradio_blocks/)."""
