"""The yardstick: finding a cell's files by name, its traffic loops, the
timing and trace arithmetic, the work counts and the comparison that decides
``correct``.  The program under test is reached only through the entries in
``perfbench/entries``."""
