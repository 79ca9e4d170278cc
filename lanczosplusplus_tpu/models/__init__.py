from lanczosplusplus_tpu.models.registry import build_model  # noqa: F401


def factored_hamiltonian_or_none(model, basis, parts, dtype, warn=None,
                                 cross_dtype=None):
    """The half-cut block-factorized Hamiltonian for models that have
    one (arbitrary-S Heisenberg Sz sectors, Kitaev full space, Rashba
    SOC total-N sectors, t-J spatial half-cut, FeAs spin-orbit
    (nup,ndown) union blocks), or None.  Shared by Engine
    (SolverOptions=factored) and the FTLM schedule so the model-dispatch
    logic lives in exactly one place.  Model restrictions a factored
    builder cannot serve (e.g. asymmetric Heisenberg couplings) return
    None too, so every caller keeps its flat-path fallback.  `warn` is
    an optional callable(str): invoked with the reason whenever the
    factored form is unavailable, so SolverOptions=factored never
    degrades to the flat gather path silently."""
    name = type(model).__name__
    try:
        if name == "KitaevModel":
            from lanczosplusplus_tpu.models.kitaev_factored import \
                build_factored_kitaev
            return build_factored_kitaev(model, basis, dtype=dtype)
        if name == "HeisenbergModel":
            from lanczosplusplus_tpu.models.heisenberg_factored import \
                FactoredHeisenbergChain
            nsite = model.geometry.number_of_sites()
            fact = FactoredHeisenbergChain(model, nsite, parts[1],
                                           dtype=dtype)
            return fact.flat_ham(basis)
        if name == "RashbaSOCModel":
            # spatial half-cut: within-half Rashba flips run as
            # GEMMs; only cut-crossing bonds stay gather-typed
            from lanczosplusplus_tpu.models.rashba_halfcut import \
                build_halfcut_rashba
            return build_halfcut_rashba(model, basis, dtype=dtype,
                                        cross_dtype=cross_dtype)
        if name == "TjMultiOrbModel":
            from lanczosplusplus_tpu.models.tj_factored import \
                build_factored_tj
            return build_factored_tj(model, basis, dtype=dtype,
                                     cross_dtype=cross_dtype)
        if name == "FeAsSpinOrbitModel":
            from lanczosplusplus_tpu.models.feas_spinorbit_factored import \
                build_factored_feas_spinorbit
            return build_factored_feas_spinorbit(model, basis, dtype=dtype)
        if name == "FeBasedScModel":
            # single-block BlockKron: dense one-spin hop GEMMs + exact
            # (dn ⊗ up) channels for the interaction remainder (the
            # flat ELL's whole-dim gathers are avoided).  Dense
            # one-spin operators cap the reachable
            # sector size; past the cap the flat path stays the answer
            szu, szd = basis.up.size, basis.down.size
            if szu * szu + szd * szd > (1 << 26):
                raise NotImplementedError(
                    f"one-spin dims ({szu}, {szd}) too large for the "
                    "dense block-Kronecker factors")
            return model.block_kron_hamiltonian(basis, dtype=dtype)
    except NotImplementedError as e:
        if warn is not None:
            warn(f"SolverOptions=factored: no factored form for "
                 f"{name} on this input ({e}); falling back to the "
                 f"flat gather path")
        return None
    if warn is not None:
        warn(f"SolverOptions=factored: {name} has no factored "
             f"builder; falling back to the flat gather path")
    return None
