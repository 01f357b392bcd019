"""Motion planning of the port: screw + IK solvers, RRT-Connect and the
scripted task solutions."""
