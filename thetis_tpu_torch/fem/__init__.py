"""Reference elements, DG function spaces, the matrix-free DG assembler
and its extruded-prism counterpart ``Assembler3D``."""
