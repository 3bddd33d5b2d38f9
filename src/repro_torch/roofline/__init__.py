"""The roofline model of the port: the H100's constants (``hw``) and
the round counter and per-round prediction the plan controller's cost
model reads (``analysis``)."""
