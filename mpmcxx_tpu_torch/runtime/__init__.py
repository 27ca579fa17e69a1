"""Native runtime: the PQR codec and the restart writer thread."""
