"""The paper's two-phase pipeline in the port: filtering, joins, the
batch step, the micro-batch stream and the partition worker pool."""
