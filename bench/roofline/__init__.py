"""Operation and byte counts of each kind of work, one file each."""
