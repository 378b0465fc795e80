"""The sharding rule tables of the reference's production meshes, as
pure functions of shapes and mesh axis sizes (``sharding``)."""
