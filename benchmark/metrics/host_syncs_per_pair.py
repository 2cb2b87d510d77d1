"""The traced calls' synchronising runtime calls (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, synchronous
``cudaMemcpy``) that start inside a program span, over the traced pairs. A
pageable copy to the card is a ``cudaMemcpyAsync`` followed by a
``cudaStreamSynchronize``, so each counts here as one sync (and its wait
shows in ``idle_share.ingest`` where it is in ``bufferx.prepare``)."""

from benchmark.spans import host_syncs_per_pair


def read(run):
    return host_syncs_per_pair(run)
