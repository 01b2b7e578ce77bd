"""Device code: rng, ray query, camera, samplers, bsdf, sky, integrator, tonemap."""
