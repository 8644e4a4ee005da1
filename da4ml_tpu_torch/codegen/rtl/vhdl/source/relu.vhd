-- Rectifier with re-quantization (DAIS opcode +/-2): v = +/-a;
-- o = 0 when v < 0 else wrap(v << SHIFT_N).
library ieee;
use ieee.std_logic_1164.all;
use ieee.numeric_std.all;
use work.da4ml_util.all;

entity relu is
    generic (WA : integer := 8; SA : integer := 1; NEG : integer := 0; SHIFT_N : integer := 0; WO : integer := 8);
    port (
        a : in std_logic_vector(WA - 1 downto 0);
        o : out std_logic_vector(WO - 1 downto 0)
    );
end entity;

architecture rtl of relu is
    function shl_n return integer is
    begin
        if SHIFT_N > 0 then
            return SHIFT_N;
        end if;
        return 0;
    end function;
    function shr_n return integer is
    begin
        if SHIFT_N < 0 then
            return -SHIFT_N;
        end if;
        return 0;
    end function;
    constant SHL : integer := shl_n;
    constant SHR : integer := shr_n;
    constant WI : integer := imax(WA, WO + SHR) + SHL + 2;
    signal ea, v, shifted : signed(WI - 1 downto 0);
begin
    ea <= ext(a, SA, WI);
    v <= -ea when NEG = 1 else ea;
    shifted <= shift_right(shift_left(v, SHL), SHR);
    o <= (others => '0') when v(WI - 1) = '1' else std_logic_vector(shifted(WO - 1 downto 0));
end architecture;
