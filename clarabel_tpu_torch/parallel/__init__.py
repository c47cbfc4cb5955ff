"""Batched solves over instances that share one cone layout, and the
multi-device paths: meshes and collectives (`multihost`), the sharded
block-arrow KKT (`schur`) and the dryrun launcher (`dryrun`)."""
