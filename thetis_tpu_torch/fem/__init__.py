"""Reference elements, DG function spaces and the matrix-free DG assembler."""
