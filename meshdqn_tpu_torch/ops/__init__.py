"""Device ops: the matvec kernel (csrc/matvec.cu) and the convection term."""
