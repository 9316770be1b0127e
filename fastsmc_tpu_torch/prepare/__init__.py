"""Preparation of decoding quantities (the reference's PREPARE_DECODING
tool): the coalescent transition quantities (:mod:`.transition`), the CSFS
and its array ascertainment (:mod:`.csfs`, :mod:`.conditioned_sfs`), and the
assembled artifact (:mod:`.make_dq`). Host numpy/scipy, the port's copies of
``fastsmc_tpu/prepare/``."""
