"""The yardstick's arithmetic: peaks, operation counts and byte counts."""
