"""Importers for the reference engine's on-disk formats (counterpart of
``lumixengine_tpu/importers/``): the ``.unv`` world file and its writer,
``instantiate`` (a parsed scene into an Engine and a World), shipped
navmeshes (``.nav``), animation controllers (``.act``), property
animations (``.anp``), binary FBX models and takes (``fbx``) with their
``.meta`` sidecars (``model_meta``), compiled clips (``.anm``), materials
(``.mat``) and composite textures (``.ltc``). Host code on numpy; each is
the JAX package's module with the port's imports."""
