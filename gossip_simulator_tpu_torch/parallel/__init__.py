"""The sharded backend's shard layout and exchange (S shards on one
device)."""
