"""Hardware points the deployment planner and the simulator price
against: verbatim copies of ``repro.core.hardware`` (chip constants),
``repro.core.hbmco`` (the HBM-CO design space), ``repro.core.provisioning``
(the paper's energy, area and cost models) and ``repro.core.sku`` (the
HBM-CO SKU selection map), with imports redirected; all pure Python."""
