"""Scene builders: one module a scene, named by a configuration's
``"scene"``. Each draws the scene's inputs from the seed (``draw``) and
builds the engine under test from the configuration and those inputs
(``build``); ``common.capture`` clones the dynamic state the reference is
compared on."""
