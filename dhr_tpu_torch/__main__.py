from dhr_tpu_torch.cli.main import main

main()
