"""On-card measurement entry points: the probes' and the resampler's A/B
functions (``probes``) and the WSOLA A/B tool (``ab_wsola_fps``)."""
