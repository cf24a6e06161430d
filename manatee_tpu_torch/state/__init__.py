"""The model checker of the cluster state machine, ported: copies of the
machine and its checker (types, canon, machine, modelcheck, with the
outside calls they make in _support) and the array engine (mc_array),
whose frontier step, liveness and dedup run as the hand kernels K5, K6
and K7 on the card."""
