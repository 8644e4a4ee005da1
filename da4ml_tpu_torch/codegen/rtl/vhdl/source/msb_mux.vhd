-- MSB-select mux (DAIS opcode +/-6): sel = top bit of c;
-- o = sel ? wrap(a << SH0) : wrap((+/-b) << SH1).
library ieee;
use ieee.std_logic_1164.all;
use ieee.numeric_std.all;
use work.da4ml_util.all;

entity msb_mux is
    generic (
        WC : integer := 8;
        WA : integer := 8;
        SA : integer := 1;
        WB : integer := 8;
        SB : integer := 1;
        NEG_B : integer := 0;
        SH0 : integer := 0;
        SH1 : integer := 0;
        WO : integer := 8
    );
    port (
        c : in std_logic_vector(WC - 1 downto 0);
        a : in std_logic_vector(WA - 1 downto 0);
        b : in std_logic_vector(WB - 1 downto 0);
        o : out std_logic_vector(WO - 1 downto 0)
    );
end entity;

architecture rtl of msb_mux is
    function pos_part(s : integer) return integer is
    begin
        if s > 0 then
            return s;
        end if;
        return 0;
    end function;
    constant SHL0 : integer := pos_part(SH0);
    constant SHR0 : integer := pos_part(-SH0);
    constant SHL1 : integer := pos_part(SH1);
    constant SHR1 : integer := pos_part(-SH1);
    constant WI0 : integer := imax(WA, WO + SHR0) + SHL0 + 1;
    constant WI1 : integer := imax(WB, WO + SHR1) + SHL1 + 2;
    signal ea, r0 : signed(WI0 - 1 downto 0);
    signal eb0, eb, r1 : signed(WI1 - 1 downto 0);
begin
    ea <= ext(a, SA, WI0);
    eb0 <= ext(b, SB, WI1);
    eb <= -eb0 when NEG_B = 1 else eb0;
    r0 <= shift_right(shift_left(ea, SHL0), SHR0);
    r1 <= shift_right(shift_left(eb, SHL1), SHR1);
    o <= std_logic_vector(r0(WO - 1 downto 0)) when c(WC - 1) = '1' else std_logic_vector(r1(WO - 1 downto 0));
end architecture;
