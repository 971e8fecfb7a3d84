"""Meshes, sharding and fault tolerance (the JAX package's
``distributed``): the logical-axis sharding rules (``sharding``), the
partition specs of every tree (``specs``), GPipe over a 'pp' axis
(``pipeline``), the crash-recovering TrainRunner, straggler detection and
heartbeats (``fault``) and the fault-injection harness with the elastic
re-mesh (``chaos``)."""
