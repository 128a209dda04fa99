"""Measurement tools of the port: ``probes`` is the counterpart of the
repository's ``tools/`` probes (the TPU's phase knockouts, dot ceilings
and K-buffer builds), run on the card."""
