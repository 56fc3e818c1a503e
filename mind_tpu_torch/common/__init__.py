"""Host and device primitives of the port: device choice, kinematics, geometry."""
