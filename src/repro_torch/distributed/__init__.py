"""Fault tolerance on one device: the crash-recovering TrainRunner,
straggler detection, heartbeats and the fault-injection harness (the JAX
package's ``distributed``; its meshes and sharding are not ported)."""
