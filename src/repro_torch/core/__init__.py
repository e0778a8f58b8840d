"""Host-side core of the port: formats, epilogues, the Hopper geometry
solver and the GEMM plan cache."""
