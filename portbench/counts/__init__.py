"""Operation and byte counts of the work the cells' inputs need, one
function per file, from shapes and counted misses only."""
