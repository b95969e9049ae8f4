"""The kinds of run a cell drives, one file each, named as the entry."""
