"""CLI applications (reference layer L8): the six entry points
nsol_run_denoising, nsol_run_deconvolution, nsol_run_denoising_study,
nsol_run_deconvolution_study, nsol_show_parameter_study, nsol_corrupt_data
(reference: nsol/application/*.py + setup.py:60-69)."""
