"""The parallel plane: lane meshes (`mesh`), process groups
(`distributed`), the cluster step and merge (`cluster`), and the
sequence plane's attention: `flash_attention` (K3) and the single-device
streaming and materialised versions in `ring_attention`. The package
re-exports nothing: import the module."""
